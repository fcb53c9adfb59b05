from naf_torch.ops.adaptive_conv import adaptive_conv, reflect_pad2d, unfold_nhwc  # noqa: F401
from naf_torch.ops.na2d import cross_scale_na2d, na2d  # noqa: F401
from naf_torch.ops.pool import adaptive_avg_pool2d  # noqa: F401
from naf_torch.ops.resize import (  # noqa: F401
    resize_bicubic,
    resize_bilinear,
    resize_nearest_exact,
)
from naf_torch.ops.window import (  # noqa: F401
    cross_scale_lr_indices,
    na_gather_indices,
    na_window_start,
    nearest_exact_src_index,
)
