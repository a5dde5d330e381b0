from .resnet import ResNetFeatures
from .efficientnet import EfficientNetFeatures
from .simple import SimpleConvFeatures
from .encoder import ViewEncoder, build_backbone

__all__ = [
    "ResNetFeatures",
    "EfficientNetFeatures",
    "SimpleConvFeatures",
    "ViewEncoder",
    "build_backbone",
]
