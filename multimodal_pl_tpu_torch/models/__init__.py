"""The FEAM segmenter and its building blocks."""

from multimodal_pl_tpu_torch.models.tokens import TOKEN_DIMS, init_class_tokens
from multimodal_pl_tpu_torch.models.unet3d import UNet3DFEAM

__all__ = ["TOKEN_DIMS", "UNet3DFEAM", "init_class_tokens"]
