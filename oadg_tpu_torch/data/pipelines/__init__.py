"""Host pipelines of the port's test and train paths; importing this
registers them."""
from .formatting import (Collect, Compose, DefaultFormatBundle, ImageToTensor,
                         MultiScaleFlipAug)
from .loading import (LoadAnnotations, LoadImageFromFile, LoadImageFromWebcam,
                      LoadPanopticAnnotations)
from .oa_mix import OAMix
from .transforms import (Corrupt, Expand, MinIoURandomCrop, Normalize, Pad,
                         PhotoMetricDistortion, RandomFlip, Resize)

__all__ = ["Collect", "Compose", "DefaultFormatBundle", "ImageToTensor",
           "MultiScaleFlipAug", "LoadAnnotations", "LoadImageFromFile",
           "LoadImageFromWebcam", "LoadPanopticAnnotations", "OAMix", "Corrupt", "Expand", "MinIoURandomCrop",
           "Normalize", "Pad", "PhotoMetricDistortion", "RandomFlip", "Resize"]
