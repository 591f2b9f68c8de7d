"""sign_ops_ms: the program's host seconds in the sign loop's own work
between its multiplies: the set-up (desymmetrize, the Gershgorin norm,
the copy and its scale), each step's shift of X² to 3I - X², and each
step's convergence check (the difference, its norm and the guard's)
(regions ``models_sign_setup``, ``models_sign_shift`` and
``models_sign_check``, `read_totals()["regions"]`), per loop (a window
step), in ms; none where the program does not time them."""

NAMES = ("models_sign_setup", "models_sign_shift", "models_sign_check")


def read(run):
    regions = run.counters.get("regions", {})
    found = [regions[n]["seconds"] for n in NAMES if n in regions]
    return sum(found) / run.steps * 1e3 if found and run.steps else None
