from .pipeline import DataConfig, DomainSpec, make_domain, sample_batch, token_stream

__all__ = ["DataConfig", "DomainSpec", "make_domain", "sample_batch",
           "token_stream"]
