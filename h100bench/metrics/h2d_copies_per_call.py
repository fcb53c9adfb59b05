"""Host-to-device copies per call that the program charged to its spans
(``naf_torch.utils.spans.to_device``): pageable copies, each of which holds
the host until the device reaches it."""

from h100bench.metrics.program_spans import copies_per_call


def read(ctx):
    return copies_per_call(ctx)
