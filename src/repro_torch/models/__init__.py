"""The LM stack: configs, blocks, the dense ``TransformerLM`` and its
factory (counterpart of ``repro.models``)."""
