"""Build the port's CUDA sources at first use.

Each `csrc/*.cu` file has a plain C interface and is compiled by `nvcc` into
a shared library that `ctypes` loads (no PyTorch headers: a build takes
seconds, not minutes).  Libraries land in `build/kernels/` at the root of the
checkout, which `.gitignore` lists, under a name keyed by the source's hash,
the compile flags and the caller's key (the model's sizes and constants), so
a changed source or model builds anew and an unchanged one is reused.

The same sources also build as host C++ with `g++` (`host=True`): the CPU
tests use that build to check a kernel's arithmetic without a card, and the
telemetry sink (`csrc/telemetry_sink.cpp`, host code only) builds that way.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Mapping, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# nvcc into a .so with a plain C interface, loaded with ctypes.
# -fmad=false: see the note at the top of csrc/fused_step.cu.  -Xptxas -v
# reports registers, stack frame and spills, kept in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# -pthread: the telemetry sink (csrc/telemetry_sink.cpp) runs a writer thread
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
              "-pthread")
HOST_CXX = "g++"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return nvcc


def build(
    source: str,
    defines: Mapping[str, int],
    key: bytes = b"",
    host: bool = False,
    out_dir: Path | None = None,
) -> Tuple[Path, str, bool]:
    """Compile `csrc/<source>` with `-D` defines; returns (library path, the
    compiler's log, whether it was built now rather than found)."""
    src = CSRC / source
    text = src.read_bytes()
    compiler = HOST_CXX if host else find_nvcc()
    flags = list(HOST_FLAGS if host else NVCC_FLAGS)
    dflags = [f"-D{k}={int(v)}" for k, v in sorted(defines.items())]
    digest = hashlib.sha256(
        text + "\0".join([compiler] + flags + dflags).encode() + key
    ).hexdigest()[:16]
    out_dir = Path(out_dir) if out_dir is not None else BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{src.stem}_{'host' if host else 'sm90a'}_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text(), False
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            [compiler, *flags, *dflags, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src.name} failed ({compiler}, rc={proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, log.read_text(), True
