"""sign_steps: the sign loops' Newton–Schulz steps over the loops run in
the window, from the program's own counter
(`read_totals()["models"]["sign"]`, "steps" over "loops"); none where
the program does not count its loops."""


def read(run):
    sign = run.counters.get("models", {}).get("sign")
    return sign["steps"] / sign["loops"] if sign and sign.get("loops") else None
