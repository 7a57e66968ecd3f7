"""Host pipelines of the port's test path; importing this registers them."""
from .formatting import (Collect, Compose, DefaultFormatBundle, ImageToTensor,
                         MultiScaleFlipAug)
from .loading import LoadAnnotations, LoadImageFromFile, LoadImageFromWebcam
from .transforms import Normalize, Pad, RandomFlip, Resize

__all__ = ["Collect", "Compose", "DefaultFormatBundle", "ImageToTensor",
           "MultiScaleFlipAug", "LoadAnnotations", "LoadImageFromFile",
           "LoadImageFromWebcam", "Normalize", "Pad", "RandomFlip", "Resize"]
