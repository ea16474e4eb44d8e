"""Networks: the tri-plane generator G, its StyleGAN2 parts, the
superresolution modules, the ResNeXt50 encoder E, the depth discriminator D,
the EG3D dual discriminators and the StyleGAN3 generator (`stylegan3`)."""

from . import stylegan3
from .dual_discriminator import (DualDiscriminator, DummyDualDiscriminator,
                                 SingleDiscriminator, filtered_resizing)
from .encoder import ResNeXt50Encoder
from .stylegan2 import (Conv2dLayer, Discriminator, DiscriminatorBlock, DiscriminatorEpilogue,
                        FullyConnectedLayer, Generator, MappingNetwork, SynthesisBlock,
                        SynthesisLayer, SynthesisNetwork, ToRGBLayer, minibatch_std,
                        modulated_conv2d, normalize_2nd_moment)
from .superresolution import SR_REGISTRY, SuperresolutionHybrid8XDC, make_superresolution
from .triplane import DEFAULT_RENDERING_KWARGS, OSGDecoder, TriPlaneGenerator

__all__ = [
    "Conv2dLayer", "DEFAULT_RENDERING_KWARGS", "Discriminator", "DiscriminatorBlock",
    "DiscriminatorEpilogue", "DualDiscriminator", "DummyDualDiscriminator",
    "FullyConnectedLayer", "Generator", "MappingNetwork", "OSGDecoder", "ResNeXt50Encoder",
    "SR_REGISTRY", "SingleDiscriminator", "SuperresolutionHybrid8XDC", "SynthesisBlock",
    "SynthesisLayer", "SynthesisNetwork", "ToRGBLayer", "TriPlaneGenerator", "filtered_resizing",
    "make_superresolution", "minibatch_std", "modulated_conv2d", "normalize_2nd_moment",
    "stylegan3",
]
