"""Convenience namespace: the port's cross-cutting utilities (port of
cips_tpu/utils/__init__.py).

The reference keeps helpers under per-workload ``utils/`` directories; the
port's canonical homes are its data/, ops/ and training/ packages. This
module re-exports the names the JAX package's ``utils`` re-exports, each the
port's counterpart.
"""

from cips_tpu_torch.data import mgz, nifti  # noqa: F401
from cips_tpu_torch.data.dataset import (  # noqa: F401
    BatchLoader,
    MCIClassificationDataset,
    PackedDataset,
    PairedLatentDataset,
    PairedVolumeDataset,
    StreamingLoader,
    pack_pairs,
)
from cips_tpu_torch.ops.metrics import mae, ms_ssim, psnr, ssim  # noqa: F401
from cips_tpu_torch.training.common import (  # noqa: F401
    CheckpointManager,
    MetricWriter,
    StepTimer,
    guard_nonfinite,
)
from cips_tpu_torch.training.profiling import device_memory_report, timed_steps, trace  # noqa: F401
