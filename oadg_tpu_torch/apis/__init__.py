"""Inference and test APIs of the port."""
from .inference import (DetectorHandle, inference_detector, init_detector,
                        prepare_batch, prepare_image)
from .test import (build_test_loader, load_model_state, run_test,
                   single_gpu_test)

__all__ = ["DetectorHandle", "inference_detector", "init_detector",
           "prepare_batch", "prepare_image", "build_test_loader",
           "load_model_state", "run_test", "single_gpu_test"]
