"""Render the port's measured-numbers block of README from its artifacts.

Counterpart of `tpu_dialmpc/tools/readme_table.py` for the port's own
artifacts: the newest QUALITY_TORCH*_r{N}.json (the gates on the card,
written by `python -m tpu_dialmpc_torch.quality`) and
BENCH_TORCH_LAST_GOOD.json (the benchmark rows, written by the CLI's
`bench --out`), each with the card's name and power limit.  The block sits
in README's port section between HTML markers:

    <!-- BEGIN GENERATED: port-numbers ... -->
    ...
    <!-- END GENERATED: port-numbers -->

The marker name does not start with `measured-numbers`, the JAX block's, so
the JAX generator never takes this block for its own, and this one leaves
that block byte for byte as it is.

Usage:
    python -m tpu_dialmpc_torch.tools.readme_table           # rewrite README.md
    python -m tpu_dialmpc_torch.tools.readme_table --check   # exit 1 on drift
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys

BEGIN_RE = re.compile(r"<!-- BEGIN GENERATED: port-numbers[^>]*-->")
END = "<!-- END GENERATED: port-numbers -->"
BENCH_FILE = "BENCH_TORCH_LAST_GOOD.json"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _latest_quality(root: str) -> tuple[str, dict] | None:
    """The newest round's QUALITY_TORCH artifact; in one round the full
    lane before the quick one."""
    found = []
    for path in glob.glob(os.path.join(root, "QUALITY_TORCH*_r*.json")):
        m = re.search(r"QUALITY_TORCH(_QUICK)?_r(\d+)\.json$", path)
        if m:
            found.append((int(m.group(2)), m.group(1) is None, path))
    if not found:
        return None
    path = max(found)[2]
    with open(path) as f:
        return os.path.basename(path), json.load(f)


def _bench(root: str) -> tuple[str, dict] | None:
    p = os.path.join(root, BENCH_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return BENCH_FILE, json.load(f)


def _fmt(v, nd=3):
    if isinstance(v, float):
        s = f"{v:.{nd}f}"
        return s.rstrip("0").rstrip(".") if "." in s else s
    return str(v)


def _card(doc) -> str:
    card = doc.get("device", "?")
    return f"{card} at {doc['power_limit']}" if doc.get("power_limit") else card


def render(root: str | None = None) -> str:
    """The generated block (markers included)."""
    root = root or _repo_root()
    lines: list[str] = []
    sources = []

    b = _bench(root)
    if b:
        src, doc = b
        sources.append(src)
        lines += [
            "",
            f"**Benchmark** ({src}, measured {doc.get('measured_at', '?')}, "
            f"platform {doc.get('platform', '?')}, {_card(doc)}):",
            "",
            "| metric | value | unit | vs budget |",
            "|---|---|---|---|",
        ]
        rows = [doc] + [e for e in doc.get("extra", []) if e.get("metric") != "skipped"]
        proxies = []
        for r in rows:
            nd = 6 if r["unit"].startswith("fraction") else 3  # the port keeps 6 there
            if r.get("budget_basis") == "go2-proxy":
                proxies.append(r)
                vs = "— ¹"
            else:
                vs = _fmt(r.get("vs_baseline", ""), nd)
            lines.append(f"| {r['metric']} | {_fmt(r['value'], nd)} | {r['unit']} | {vs} |")
        if proxies:
            lines += [
                "",
                "¹ The budget of this row is the Go2's 10 ms at N2048/H20 scaled to its "
                "shape (budget_basis go2-proxy): a cross-model ratio, not a verdict on "
                "this task's real-time budget ("
                + ", ".join(f"{r['metric']} vs_baseline {_fmt(r.get('vs_baseline', '?'))}"
                            for r in proxies) + ").",
            ]
        roof = next((e for e in doc.get("extra", []) if "roofline" in e.get("metric", "")),
                    None)
        if roof and "measured_ms_attempts" in roof:
            lines += [
                "",
                f"Roofline provenance: measured fp32 roof "
                f"{_fmt(roof.get('microbench_peak_gops', '?'), 2)} Gops/s, "
                f"raised by kernel evidence: "
                f"{roof.get('roof_raised_by_kernel_evidence', '?')}; "
                f"kernel ms across attempts {roof['measured_ms_attempts']} (fraction at "
                f"the median attempt {_fmt(roof.get('fraction_at_median_attempt', '?'), 6)}).",
            ]

    q = _latest_quality(root)
    if q:
        src, doc = q
        sources.append(src)
        stamps = sorted({g["measured_at"] for g in doc.get("gates", []) if g.get("measured_at")})
        if len(stamps) > 1:
            when = f"{stamps[0]} .. {stamps[-1]}"
        else:
            when = stamps[0] if stamps else doc.get("measured_at", "?")
        lines += [
            "",
            f"**Quality gates** ({src}, {doc.get('lane', '?')} lane, measured {when}, "
            f"platform {doc.get('platform', '?')}, {_card(doc)}, "
            f"{_fmt(doc.get('wall_s', 0) / 60, 1)} min wall; stand-in scenes):",
            "",
            "| gate | steps | distance (m) | z_min (m) | dones | worst cause | failed checks "
            "| passed |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for g in doc.get("gates", []):
            m = g["metrics"]
            causes = {
                "inverted": m.get("dones_inverted_mean"),
                "joint": m.get("dones_joint_mean"),
                "height": m.get("dones_height_mean"),
            }
            worst = max(causes, key=lambda k: causes[k] or 0.0)
            cause = "—" if (causes[worst] or 0.0) == 0.0 else f"{worst} {_fmt(causes[worst])}"
            failed = ", ".join(
                f"{c['metric']} {_fmt(c['measured'])} (needs {c['op']} {_fmt(c['threshold'])})"
                for c in g["checks"] if not c["passed"]) or "—"
            lines.append(
                f"| {g['gate']} | {g['n_steps']} | {_fmt(m.get('x_final'), 2)} "
                f"| {_fmt(m.get('z_min'), 3)} | {_fmt(m.get('dones_mean'), 4)} "
                f"| {cause} | {failed} | {'yes' if g['passed'] else 'NO'} |"
            )

    header = (
        f"<!-- BEGIN GENERATED: port-numbers (from {', '.join(sources) or 'no artifact yet'} "
        "by tpu_dialmpc_torch/tools/readme_table.py — do not edit by hand) -->"
    )
    return "\n".join([header] + lines + ["", END])


def apply(readme_path: str | None = None, check: bool = False, root: str | None = None) -> int:
    """Rewrite (or, with `check`, compare) the port-numbers block of
    `readme_path` (default: README.md at `root`, the repository root)."""
    root = root or _repo_root()
    readme_path = readme_path or os.path.join(root, "README.md")
    with open(readme_path) as f:
        text = f.read()
    m = BEGIN_RE.search(text)
    if not m or END not in text:
        print("README.md has no port-numbers markers", file=sys.stderr)
        return 1
    start, stop = m.start(), text.index(END) + len(END)
    new = text[:start] + render(root) + text[stop:]
    if check:
        if new != text:
            print(
                "README port-numbers block is stale — run "
                "`python -m tpu_dialmpc_torch.tools.readme_table`",
                file=sys.stderr,
            )
            return 1
        return 0
    if new != text:
        with open(readme_path, "w") as f:
            f.write(new)
        print(f"updated {readme_path}")
    else:
        print("README already up to date")
    return 0


if __name__ == "__main__":
    sys.exit(apply(check="--check" in sys.argv))
