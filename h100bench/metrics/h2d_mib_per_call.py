"""MiB per call copied from the host to the device through the program's
``naf_torch.utils.spans.to_device`` and charged to its spans: the size of
the pageable copies that h2d_copies_per_call counts."""

from h100bench.metrics.program_spans import mib_per_call


def read(ctx):
    return mib_per_call(ctx)
