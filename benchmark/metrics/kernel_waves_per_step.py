"""kernel_waves_per_step: the physics kernel's waves per control step: each
launch of B samples takes ceil(B / the samples the card holds at once)
waves, counted by the program (`FusedStep.waves`, which a replay of the
captured step adds to), over the traced steps.  None on a program without
the counter."""


def read(ctx):
    waves = (getattr(ctx, "kernel_launches", None) or {}).get("FusedStep.waves")
    return None if not waves else waves / ctx.traced_steps
