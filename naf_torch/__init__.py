"""naf_torch: NAF zero-shot feature upsampling and its training in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of ``naf_tpu`` (JAX/Pallas), module by module under the same names:

- ``naf_torch.ops``      resize, pooling, window math, the attention oracle,
                         the spatially varying conv
- ``naf_torch.nn``       conv encoder, RoPE, cross-scale attention
- ``naf_torch.kernels``  the CUDA kernels (``csrc/``), built with nvcc at
                         first use, each beside its plain PyTorch version
- ``naf_torch.models``   NAF, and the baselines (FeatUp, JBU, JBF, AnyUp,
                         JAFAR, Bilinear, Nearest) behind
                         ``models.registry.ModelWrapper``
- ``naf_torch.api``      ``naf``, ``load_naf_params``, ``NAFUpsampler``,
                         ``naf_streamed`` (outputs above 2K, in row bands)
- ``naf_torch.backbones`` the DINOv2 ViT and its wrapper (distillation targets)
- ``naf_torch.train``    self-distillation training (``python -m naf_torch.train``;
                         ``mesh=data`` under torchrun for data parallelism)
- ``naf_torch.parallel`` the (data, space) mesh, the spatially sharded
                         forward, ``run_ranks``; ``python -m naf_torch.dryrun``
                         runs both over N ranks
- ``naf_torch.config``, ``naf_torch.data``, ``naf_torch.utils``  the CLI's
                         config loader, image-folder data and PCA panels

Importing the package builds and loads nothing.
"""

__version__ = "0.1.0"

from naf_torch.api import NAFUpsampler, load_naf_params, naf, naf_streamed  # noqa: F401
