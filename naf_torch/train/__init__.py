"""Self-distillation training of NAF (counterpart of ``naf_tpu/train``).

    python -m naf_torch.train synthetic=true img_size=448 train_steps=20
"""
