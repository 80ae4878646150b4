from repro_torch.data.tokens import synthetic_lm_batches, synthetic_requests
