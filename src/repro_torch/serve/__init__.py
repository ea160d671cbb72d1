from repro_torch.serve.engine import DECODE, DONE, PREFILL, QUEUED, Engine, Request

__all__ = ["Engine", "Request", "QUEUED", "PREFILL", "DECODE", "DONE"]
