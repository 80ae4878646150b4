"""Pipeline serving engine: real PyTorch models behind each stage.

StageServer = one task's deployment: a set of model variants (ArchConfig),
a batch size and a replica count. Every variant's model is built on
``device`` when the stage is created, so a variant switch swaps models
without a rebuild. On a CUDA device each variant's attention runs through
the hand-written Hopper kernels.

PipelineServer chains stages and implements ``apply_config``, the
reconfiguration the OPD agent calls.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.mdp import Config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.serving.batcher import Batcher, Request


class StageServer:
    def __init__(self, name: str, variants: list[ArchConfig], *,
                 seq_len: int = 32, batch_size: int = 4, replicas: int = 1,
                 seed: int = 0, device="cuda"):
        self.name = name
        self.variants = variants
        self.seq_len = seq_len
        self.device = resolve_device(device)
        self.params = [api.init_model(seed + i, cfg, device=self.device)
                       for i, cfg in enumerate(variants)]
        self.z = 0
        self.replicas = replicas
        self.batcher = Batcher(batch_size, seq_len)
        self.served = 0

    @property
    def cfg(self) -> ArchConfig:
        return self.variants[self.z]

    def configure(self, *, z: int | None = None, batch_size: int | None = None,
                  replicas: int | None = None):
        if z is not None:
            self.z = int(z) % len(self.variants)
        if batch_size is not None:
            self.batcher.batch_size = int(batch_size)
        if replicas is not None:
            self.replicas = int(replicas)

    def _make_batch(self, tokens: np.ndarray, cfg: ArchConfig) -> dict:
        """Tokens on the device, plus the stub frontends' inputs, both f32
        normal with std 0.02 as the reference draws them: the vlm family's
        vision embeddings [B, n_patches, d] from a generator seeded 0 (the
        reference's ``PRNGKey(0)``), the audio family's encoder states
        [B, enc_len, d] from one seeded 1 (``PRNGKey(1)``). The bits differ
        from ``jax.random``'s."""
        B = tokens.shape[0]
        batch = {"tokens": torch.as_tensor(tokens % cfg.vocab, device=self.device)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = self._stub_inputs((B, cfg.n_patches, cfg.d_model), 0)
        if cfg.family == "audio":
            batch["enc_states"] = self._stub_inputs((B, cfg.enc_len, cfg.d_model), 1)
        return batch

    def _stub_inputs(self, shape, seed: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device,
                           dtype=torch.float32) * 0.02

    def execute(self, z: int, tokens: np.ndarray) -> np.ndarray:
        """Run variant ``z`` on tokens [B, S] -> output tokens [B, S] int32,
        the argmax of the forward logits (the first maximal index, as in the
        reference). Batches run at their actual size (no tail padding). Its
        spans are ``tracing``'s ``execute`` and the three inside it."""
        z = int(z) % len(self.variants)
        cfg = self.variants[z]
        B, S = tokens.shape
        with tracing.execute(stage=self.name, arch=cfg.name, B=B, S=S), torch.inference_mode():
            with tracing.inner("execute.inputs"):
                batch = self._make_batch(tokens, cfg)
            with tracing.inner("execute.forward"):
                logits, _ = api.forward(self.params[z], batch, cfg)
            with tracing.inner("execute.output"):
                return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def serve_pending(self) -> list[Request]:
        """Drain the queue; returns completed requests with stage output."""
        done = []
        while True:
            nb = self.batcher.next_batch()
            if nb is None:
                return done
            reqs, toks = nb
            out = self.execute(self.z, toks)
            for i, req in enumerate(reqs):
                req.stage_outputs.append(out[i])
                req.result = out[i]
                done.append(req)
            self.served += len(reqs)


class PipelineServer:
    def __init__(self, stages: list[StageServer]):
        self.stages = stages
        self.completed: list[Request] = []
        self.switch_count = 0

    def apply_config(self, cfg: Config, batch_choices: list[int] | None = None):
        """The OPD action -> live reconfiguration."""
        for n, stage in enumerate(self.stages):
            if stage.z != cfg.z[n] % len(stage.variants):
                self.switch_count += 1
            stage.configure(z=cfg.z[n], batch_size=cfg.b[n], replicas=cfg.f[n])

    def submit(self, req: Request):
        self.stages[0].batcher.put(req)

    def process(self) -> list[Request]:
        """Push every queued request through all stages."""
        for i, stage in enumerate(self.stages):
            finished = stage.serve_pending()
            if i + 1 < len(self.stages):
                for req in finished:
                    # next stage consumes this stage's output tokens
                    req.tokens = np.asarray(req.result, dtype=np.int32)
                    self.stages[i + 1].batcher.put(req)
            else:
                self.completed.extend(finished)
        return self.completed
