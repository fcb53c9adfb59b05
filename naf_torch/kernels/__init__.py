"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its plain
PyTorch version in the same module. Nothing is built at import time."""


def launch_counts() -> dict:
    """Each kernel's launches so far in this process, by its wrapper's
    counter: K1 ``gn_silu_conv_fused``, K2 ``naf_upsample_attention``, K3 /
    K4 ``cross_scale_na2d_fused`` (K4 counts each band; ``k4_chunked`` the
    K4 calls on the bf16 chunked boxes' two launches, also in ``k4``), K5
    ``adaptive_conv_fused``, K6 ``gn_silu_conv_dual_fused``, the keys
    kernel ``rope_keys`` (the pooled RoPE keys and tables) and the stem
    kernel ``stem_conv_fused`` (one a stack). A caller reads
    the launches of a stretch of work as the difference of two readings."""
    from naf_torch.kernels.adaptive_conv_fused import adaptive_conv_fused
    from naf_torch.kernels.encoder_fused import (
        gn_silu_conv_dual_fused,
        gn_silu_conv_fused,
        stem_conv_fused,
    )
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
    from naf_torch.kernels.rope_keys import rope_keys

    return {"k1": gn_silu_conv_fused.launches, "k2": naf_upsample_attention.launches,
            "k3": cross_scale_na2d_fused.launches, "k4": cross_scale_na2d_fused.bwd_launches,
            "k4_chunked": cross_scale_na2d_fused.route_launches["wgmma_chunked_bwd"],
            "k5": adaptive_conv_fused.launches, "k6": gn_silu_conv_dual_fused.launches,
            "keys": rope_keys.launches, "stem": stem_conv_fused.launches}


def launches_since(before: dict) -> dict:
    """The launches of each kernel since the reading ``before``."""
    return {k: v - before[k] for k, v in launch_counts().items()}
