from ife_tpu_torch.io.nifti import read_nifti, write_nifti  # noqa: F401
from ife_tpu_torch.io.hr2 import read_hr2, write_hr2  # noqa: F401
from ife_tpu_torch.io.octave import read_octave, write_octave  # noqa: F401
from ife_tpu_torch.io.volume_io import read_volume, write_volume  # noqa: F401
