from production_stack_tpu_torch.router.stats.engine_stats import (  # noqa: F401
    EngineStats,
    EngineStatsScraper,
    PrefixIndexSnapshot,
    get_engine_stats_scraper,
    initialize_engine_stats_scraper,
)
from production_stack_tpu_torch.router.stats.request_stats import (  # noqa: F401
    RequestStats,
    RequestStatsMonitor,
    get_request_stats_monitor,
    initialize_request_stats_monitor,
)
