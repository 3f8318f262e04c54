"""Write the per-tensor SHA-256 digest of HF's seeded xlsr-53 init, the
golden that ``chip_smoke.py`` holds the port's seeded init to on the
card's machine (which has no ``transformers``).

Run from the repository root, on a host with ``transformers`` (about 10
s and 1.3 GB on the CPU):

    python3 scripts/torch_wav2vec2_digest.py

Builds ``transformers.Wav2Vec2Model`` at the xlsr-53 architecture that
the JAX package builds offline (``brainmagick_tpu/features/audio.py``,
random=True), seeded from the model name inside ``fork_rng`` as the JAX
package seeds it, digests every tensor of its state dict with
``models.wav2vec2.state_digest`` (the port's names), checks that the
port's own seeded init gives the same digest, and writes
``tests/golden/wav2vec2_xlsr53_init_sha256.json``.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from brainmagick_tpu_torch.features.audio import _BaseWav2Vec  # noqa: E402
from brainmagick_tpu_torch.models.wav2vec2 import (  # noqa: E402
    Wav2Vec2Config, Wav2Vec2Model, seed_of, state_digest)

GOLDEN = ROOT / "tests" / "golden" / "wav2vec2_xlsr53_init_sha256.json"


def hf_seeded(cfg: Wav2Vec2Config) -> torch.nn.Module:
    """HF's model at `cfg`, seeded as the JAX package seeds its random=True
    network."""
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    import transformers

    config = transformers.Wav2Vec2Config(
        conv_dim=list(cfg.conv_dim), conv_kernel=list(cfg.conv_kernel),
        conv_stride=list(cfg.conv_stride), conv_bias=cfg.conv_bias,
        hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
        do_stable_layer_norm=cfg.do_stable_layer_norm,
        feat_extract_norm=cfg.feat_extract_norm)
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(
            seed_of(_BaseWav2Vec.model_name))
        return transformers.Wav2Vec2Model(config)


def main() -> None:
    cfg = Wav2Vec2Config.xlsr53()
    digest = state_digest(hf_seeded(cfg).state_dict())
    port = state_digest(Wav2Vec2Model(cfg, torch.Generator().manual_seed(
        seed_of(_BaseWav2Vec.model_name))).state_dict())
    differ = [k for k in digest if port.get(k) != digest[k]]
    if differ or set(port) != set(digest):
        raise SystemExit(f"the port's seeded init differs from HF's: "
                         f"{differ[:5]}, names {set(port) ^ set(digest)}")
    GOLDEN.write_text(json.dumps(dict(
        model=_BaseWav2Vec.model_name, seed=seed_of(_BaseWav2Vec.model_name),
        torch=torch.__version__, sha256=digest), indent=1) + "\n")
    print(f"{len(digest)} tensors, equal to the port's; wrote "
          f"{GOLDEN.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
