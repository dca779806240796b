"""Continuous-batching serving engine of the port (padded path)."""
from repro_torch.serve.config import EngineConfig, add_engine_args
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.request import Request, RequestOutput

__all__ = ["EngineConfig", "Request", "RequestOutput", "ServingEngine", "add_engine_args"]
