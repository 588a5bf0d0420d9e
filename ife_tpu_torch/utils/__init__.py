from ife_tpu_torch.utils.logging import get_logger, log_json  # noqa: F401
from ife_tpu_torch.utils.profiling import stage_timer, StageMetrics  # noqa: F401
