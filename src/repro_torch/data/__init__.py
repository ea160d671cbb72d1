from repro_torch.data import mnist, pipeline, tokens

__all__ = ["mnist", "pipeline", "tokens"]
