"""DP-sync wire bytes a step: the change in ``Trainer.bytes_synced`` over
the window, divided by its steps (exact: the trainer prices each step
from its plan)."""
UNIT, LAYER, MOVES = "B/step", "sync", "tokens_per_s"


def read(rec):
    if rec.window_steps <= 0 or rec.sync_bytes_per_step <= 0:
        return None
    return rec.sync_bytes_per_step
