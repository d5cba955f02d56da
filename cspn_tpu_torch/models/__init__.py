"""Depth-completion models: ResNet encoder, Gudi decoder (subpixel and plain
forms), CSPN-UNet."""

from cspn_tpu_torch.models.convert import convert_jax_variables, load_jax_variables
from cspn_tpu_torch.models.decoder import (
    GudiUpConv,
    GudiUpConvLast,
    GudiUpProj,
    GudiUpProjCat,
    SubpixelUnpoolConv,
    UpProj,
    subpixel_unpool_conv,
    unpool2x,
)
from cspn_tpu_torch.models.unet import (
    CSPNUNet,
    cspn_unet_resnet18,
    cspn_unet_resnet34,
    cspn_unet_resnet50,
    cspn_unet_resnet101,
    cspn_unet_resnet152,
    unet_baseline_resnet18,
    unet_baseline_resnet50,
)

__all__ = [
    "CSPNUNet",
    "GudiUpConv",
    "GudiUpConvLast",
    "GudiUpProj",
    "GudiUpProjCat",
    "SubpixelUnpoolConv",
    "UpProj",
    "convert_jax_variables",
    "cspn_unet_resnet18",
    "cspn_unet_resnet34",
    "cspn_unet_resnet50",
    "cspn_unet_resnet101",
    "cspn_unet_resnet152",
    "load_jax_variables",
    "subpixel_unpool_conv",
    "unet_baseline_resnet18",
    "unet_baseline_resnet50",
    "unpool2x",
]
