"""Inference, test and training APIs of the port."""
from .inference import (DetectorHandle, async_inference_detector, inference_detector,
                        init_detector, prepare_batch, prepare_image)
from .test import (build_test_loader, collect_results_allgather, load_model_state,
                   multi_gpu_test, run_test, single_gpu_test)
from .train import init_random_seed, set_random_seed, train_detector

__all__ = ["DetectorHandle", "async_inference_detector", "inference_detector",
           "init_detector", "prepare_batch", "prepare_image", "build_test_loader",
           "collect_results_allgather", "load_model_state", "multi_gpu_test", "run_test",
           "single_gpu_test",
           "init_random_seed", "set_random_seed", "train_detector"]
