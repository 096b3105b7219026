"""rans_decode_roofline: the rANS decoders' share of their roofline over the
window: the least time the card could take for the work handed to it (the
batched `decode_many` calls the benchmark counted: symbols, coded bytes and
tables, `roofline.call_bound_s`) over the device time of the decoder
kernels by name in the trace. Nothing to read without those kernels or
calls."""

from benchmark.roofline import call_bound_s

KERNELS = ("o1_slots_kernel", "rans_decode_kernel", "unstripe_kernel")


def read(run):
    if run.summary is None or run.tap.kind != "decode":
        return None
    kernel_s = sum(run.summary.kernel_s.get(k, 0.0) for k in KERNELS)
    bound_s = sum(call_bound_s(*c) for c in run.tap.calls)
    if kernel_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s
