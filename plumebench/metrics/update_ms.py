"""The update phase's wall ms per iteration: the program's own
``time/update_ms`` of ``build_train_step(time_phases=True)`` (it
synchronises at the phase boundaries), averaged over the traced run's
phase-timed iterations."""


def read(ctx, metric):
    phases = getattr(ctx, "phase_ms", None)
    return None if phases is None else phases["update"]
