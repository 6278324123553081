from tpu_dialmpc_torch.telemetry.stream import TelemetryStream

__all__ = ["TelemetryStream"]
