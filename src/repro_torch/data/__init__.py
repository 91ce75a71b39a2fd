from repro_torch.data.tokens import TokenStream

__all__ = ["TokenStream"]
