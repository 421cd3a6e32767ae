from repro_torch.serving.engine import (GenerationConfig, RequestStats,
                                        ServeEngine)
from repro_torch.serving.bridge import (engine_from_checkpoint,
                                        serving_params_from_checkpoint)
from repro_torch.serving.traffic import (ARRIVAL_PRESETS, Request,
                                         TrafficConfig, TrafficReport, drive,
                                         generate_requests)

__all__ = [
    "ServeEngine", "GenerationConfig", "RequestStats",
    "engine_from_checkpoint", "serving_params_from_checkpoint",
    "ARRIVAL_PRESETS", "Request", "TrafficConfig", "TrafficReport",
    "drive", "generate_requests",
]
