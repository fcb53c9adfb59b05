"""Evaluations (counterpart of ``naf_tpu/evals``): the denoising metrics.
The segmentation probes and video propagation come with the evaluation
slice."""

from naf_torch.evals.denoising import DenoisingLoss, NoiseGenerator, psnr, ssim  # noqa: F401
