"""The whole step's model-FLOP utilisation over the measured window: the
model FLOPs of its tokens (``bench.flops``: 6 N + 12 L d T a token, no
recomputation) over its seconds, over the cards' bf16 peak (989 TFLOP/s a
card, the data sheet's; the card's power limit is stated beside it)."""
from bench import flops

UNIT, LAYER, MOVES = "%", "step", "tokens_per_s"


def read(rec):
    if rec.window_s <= 0:
        return None
    done = (flops.model_flops_per_token(rec.model, rec.mix["seq"])
            * rec.tokens_per_step * rec.window_steps)
    return 100.0 * done / rec.window_s / (flops.PEAK_BF16_FLOPS * rec.chips)
