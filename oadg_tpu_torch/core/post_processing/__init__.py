from .matrix_nms import fast_nms, mask_matrix_nms
from .nms import batched_nms_padded, multiclass_nms, nms_padded, soft_nms_padded

__all__ = ["nms_padded", "batched_nms_padded", "multiclass_nms", "soft_nms_padded",
           "mask_matrix_nms", "fast_nms"]
