from ife_tpu_torch.io.nifti import read_nifti, write_nifti  # noqa: F401
from ife_tpu_torch.io.hr2 import read_hr2, write_hr2  # noqa: F401
from ife_tpu_torch.io.octave import read_octave, write_octave  # noqa: F401
from ife_tpu_torch.io.volume_io import read_volume, write_volume  # noqa: F401
from ife_tpu_torch.io.roi_text import read_rois, write_rois  # noqa: F401
from ife_tpu_torch.io.text import (  # noqa: F401
    read_pair_list,
    read_text_matrix,
    read_text_sequence,
    write_matrix_csv,
    write_sequence_as_text,
)
from ife_tpu_torch.io.hist_spec import read_hist_spec, write_hist_spec  # noqa: F401
