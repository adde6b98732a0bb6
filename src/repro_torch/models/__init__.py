"""Model zoo of the port (``repro.models``): the dense GQA decoder
(:mod:`~repro_torch.models.transformer`) and the ViT-stub VLM on it
(:mod:`~repro_torch.models.vlm`), forward, training loss and serving,
behind :mod:`~repro_torch.models.registry`.  The other families are
configs only so far (the registry refuses them)."""
