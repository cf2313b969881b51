"""The model zoo: the FEAM segmenter and its ablation U-Nets, the EAM
variants, the refiner and the discriminators, with their building blocks.
Exports every name that ``multimodal_pl_tpu/models/__init__.py`` exports."""

from multimodal_pl_tpu_torch.models.blocks import GNReLUConv, NoBottleneck, ResStage, WSConv3d
from multimodal_pl_tpu_torch.models.discriminator import (
    DeepStyleDiscriminator,
    NormStyleDiscriminator,
    StyleDiscriminatorLinear,
    StyleDiscriminatorOutput,
)
from multimodal_pl_tpu_torch.models.eam import EAM, EAMBK, EAMIdentity
from multimodal_pl_tpu_torch.models.refiner import RefinerUNet3D
from multimodal_pl_tpu_torch.models.tokens import TOKEN_DIMS, init_class_tokens, renew_tokens
from multimodal_pl_tpu_torch.models.unet3d import (
    UNet3DBaseline,
    UNet3DDeepSup,
    UNet3DDynHead,
    UNet3DEAM,
    UNet3DFEAM,
)

__all__ = ["DeepStyleDiscriminator", "EAM", "EAMBK", "EAMIdentity", "GNReLUConv",
           "NoBottleneck", "NormStyleDiscriminator", "RefinerUNet3D", "ResStage",
           "StyleDiscriminatorLinear", "StyleDiscriminatorOutput", "TOKEN_DIMS", "UNet3DBaseline",
           "UNet3DDeepSup", "UNet3DDynHead", "UNet3DEAM", "UNet3DFEAM", "WSConv3d",
           "init_class_tokens", "renew_tokens"]
