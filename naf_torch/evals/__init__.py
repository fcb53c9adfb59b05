"""Evaluations (counterpart of ``naf_tpu/evals``): the denoising metrics,
linear-probe segmentation (``seg_probing``) and DAVIS label propagation with
its J&F (``video_seg``, ``video_seg_runner``); the CLIs ``python -m
naf_torch.evals.seg_probing``, ``video_seg`` and ``real_shard``, and the
quality loops ``distill`` (self-distillation, then the probes) and
``denoise_bench`` (the denoising ablation)."""

from naf_torch.evals.denoising import DenoisingLoss, NoiseGenerator, psnr, ssim  # noqa: F401
