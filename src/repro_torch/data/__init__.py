"""The deterministic synthetic token pipeline (port of ``repro.data``)."""

from repro_torch.data.pipeline import StreamState, TokenStream

__all__ = ["StreamState", "TokenStream"]
