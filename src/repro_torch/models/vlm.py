"""InternVL2-style VLM backbone (text decoder + stub vision frontend).

As in the JAX package's `repro.models.vlm`, the vision frontend is a stub:
the caller gives precomputed patch embeddings [B, num_image_tokens,
d_model], which `vision_proj` maps into the LM stream ahead of the text.
The image prefix takes the first positions, so the cache covers image and
text and its idx starts at num_image_tokens + T. Without image
embeddings the prefix is zeros. `loss_fn` takes the CE on the text
positions only, with the aux coefficient fixed at 0.01 as JAX's. On
blocks `vision_proj` is gathered over the data axes before the image
projection (every model rank holds it whole and computes it alike); the
text backbone is the transformer's.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import COMPUTE_DTYPE, dense_init, embed, param
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.layout import gathered


class VLM(Transformer):
    AXES = dict(Transformer.AXES, vision_proj=("embed", "embed_in"))

    def _build(self, cfg, device, gen) -> None:
        super()._build(cfg, device, gen)
        d = cfg.d_model
        # projector from the (stub) vision embedding space into the stream
        self.vision_proj = param(dense_init(gen, (d, d), d, device=device))

    def embed_inputs(self, tokens, img_embeds=None) -> torch.Tensor:
        B = tokens.shape[0]
        if img_embeds is None:
            img_embeds = torch.zeros(
                (B, self.cfg.num_image_tokens, self.cfg.d_model),
                dtype=COMPUTE_DTYPE, device=tokens.device)
        img = torch.matmul(img_embeds.to(COMPUTE_DTYPE),
                           gathered(self.vision_proj).to(COMPUTE_DTYPE))
        return torch.cat([img, embed(self.embed, tokens)], dim=1)

    def loss_fn(self, batch, *, q_chunk: int = 512, **_):
        tokens = batch["tokens"]
        x = self.embed_inputs(tokens, batch["img_embeds"])
        return self._loss(x, batch["labels"], x.shape[1] - tokens.shape[1],
                          0.01, q_chunk)
