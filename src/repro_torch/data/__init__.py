from repro_torch.data.tokens import synthetic_requests
