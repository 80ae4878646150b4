"""Training utilities of the port: AdamW, gradient clipping and the LM losses."""
from repro_torch.train.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.train.loss import lm_loss, chunked_lm_head_loss
