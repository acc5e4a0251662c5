"""Host-side utilities (timing, run logs)."""
from nmpc_tpu_torch.utils.timing import PhaseTimer, latency_stats, time_fn  # noqa: F401
from nmpc_tpu_torch.utils.runlog import RunLog, load_run, load_warm, save_run, save_warm  # noqa: F401
