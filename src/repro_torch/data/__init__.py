from repro_torch.data.pipeline import (LMDataConfig,  # noqa: F401
                                       Prefetcher, SensorConfig,
                                       TrafficConfig, lm_batch_for_step,
                                       make_lm_iterator, sensor_window_batch,
                                       traffic_flow_batch)
