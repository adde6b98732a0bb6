"""Model zoo of the port (``repro.models``): the dense GQA decoder
(:mod:`~repro_torch.models.transformer`), the ViT-stub VLM on it
(:mod:`~repro_torch.models.vlm`), the top-k MoE decoder
(:mod:`~repro_torch.models.moe`) and the Mamba2 SSD LM
(:mod:`~repro_torch.models.ssm`), the RecurrentGemma hybrid
(:mod:`~repro_torch.models.rglru`) and the whisper encoder-decoder
(:mod:`~repro_torch.models.encdec`): forward, training loss and
serving, behind :mod:`~repro_torch.models.registry`."""
