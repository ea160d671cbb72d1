from repro_torch.data import mnist, pipeline

__all__ = ["mnist", "pipeline"]
