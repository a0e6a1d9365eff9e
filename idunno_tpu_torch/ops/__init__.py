from idunno_tpu_torch.ops.preprocess import (  # noqa: F401
    IMAGENET_MEAN, IMAGENET_STD, center_crop, preprocess_batch)
from idunno_tpu_torch.ops.classify import top1_from_logits  # noqa: F401
