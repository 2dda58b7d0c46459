"""The whole step's or call's share of the card's bf16 peak (%): model FLOPs
per sample or image (`benchmark/work/flops.py`) times the rate of the
traced run's window, over 989 TFLOP/s."""

from ..work.peaks import BF16_FLOPS


def read(ctx, suffix):
    if ctx.kind != suffix or ctx.flops_per_item <= 0:
        return None
    return 100.0 * ctx.flops_per_item * ctx.rate / BF16_FLOPS
