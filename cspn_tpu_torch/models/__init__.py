"""Depth-completion models: ResNet encoder, Gudi decoder, CSPN-UNet."""

from cspn_tpu_torch.models.convert import convert_jax_variables, load_jax_variables
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
    "convert_jax_variables",
    "cspn_unet_resnet18",
    "cspn_unet_resnet34",
    "cspn_unet_resnet50",
    "cspn_unet_resnet101",
    "cspn_unet_resnet152",
    "load_jax_variables",
    "unet_baseline_resnet18",
    "unet_baseline_resnet50",
]
