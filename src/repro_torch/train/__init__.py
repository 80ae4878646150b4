"""Training utilities of the port: AdamW and gradient clipping (the LM
losses come with ROADMAP Queue 1 item 12)."""
from repro_torch.train.optim import adamw_init, adamw_update, clip_by_global_norm
