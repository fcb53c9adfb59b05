from naf_torch.nn.attention import CrossScaleAttention  # noqa: F401
from naf_torch.nn.conv import EncBlock, Encoder, ReflectConv  # noqa: F401
from naf_torch.nn.rope import RoPE, rotate_half  # noqa: F401
