"""Text preprocessing: descriptions -> ModernBERT embedding caches.

Counterpart of `gemm_gan_tpu/cli/preprocess.py`:

  python -m gemm_gan_tpu_torch.cli.preprocess --data_dir DIR \
      [--generate_descriptions] [--modernbert Simonlee711/Clinical_ModernBERT] \
      [--contrastive_dim 128] [--max_length 300] [--encoder_dtype bfloat16] \
      [--device cpu]

Stages (each skipped when its files exist):
  1. `descriptions.json` from the injected biomedical LLM (host side,
     `data/descriptions.py`; needs `transformers` and the LLM's weights);
  2. tokenize on the host with the checkpoint's HF tokenizer
     (`transformers.AutoTokenizer`, imported here: the card's machine has
     none, so tokenize where it is installed), encode with the port's
     `ModernBert` on the card (its weights through
     `cli.convert_encoders.modernbert_weights`: a checkpoint file, dir or
     cached hub id, validated against the published dims), and write the
     CLS parquet and the per-case token npys and masks;
  3. with `--contrastive_dim`, train the projection pair on (mean patch
     embedding, CLS) pairs and write the projected caches.

`--encoder_dtype bfloat16` computes the encoder in bf16 (Flax's rules);
the cached embeddings are f32 either way.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="gemm_gan_tpu_torch text preprocessing")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--modernbert", default="Simonlee711/Clinical_ModernBERT",
                   help="checkpoint file, dir, or hub id in the local HF cache; its "
                        "dir also holds the tokenizer")
    p.add_argument("--llm", default="ContactDoctor/Bio-Medical-Llama-3-8B")
    p.add_argument("--generate_descriptions", action="store_true")
    p.add_argument("--max_length", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--contrastive_dim", type=int, default=0,
                   help=">0 trains the projection pair and writes caches")
    p.add_argument("--contrastive_epochs", type=int, default=50)
    p.add_argument("--encoder_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="ModernBERT compute dtype; cached embeddings are f32")
    p.add_argument("--device", default=None,
                   help="'cpu' to run the encoder on the CPU; default: CUDA")
    return p


def _load_metainfos(data_dir: str) -> dict:
    js = os.path.join(data_dir, "metainfos.json")
    if os.path.exists(js):
        with open(js) as f:
            return json.load(f)
    import pickle

    with open(os.path.join(data_dir, "metainfos.pkl"), "rb") as f:
        return pickle.load(f)


def tokenize(tokenizer, descriptions: dict, max_length: int):
    """(ids_by_case, mask_by_case): each description padded and truncated to
    `max_length` by an HF tokenizer (an empty one as " ")."""
    ids_by_case, mask_by_case = {}, {}
    for case, text in descriptions.items():
        enc = tokenizer(text or " ", max_length=max_length, padding="max_length",
                        truncation=True)
        ids_by_case[case] = np.asarray(enc["input_ids"], np.int32)
        mask_by_case[case] = np.asarray(enc["attention_mask"], bool)
    return ids_by_case, mask_by_case


def encode_caches(model, ids_by_case, mask_by_case, data_dir: str, batch_size: int,
                  device=None) -> str:
    """Write the CLS parquet and the token cache under `data_dir` with
    `model` (a `ModernBert`), each unless it exists; returns the token
    cache's dir."""
    from gemm_gan_tpu_torch.encoders.cache import build_text_cls_cache, build_text_token_cache

    def encode(ids, mask):
        return model(ids, mask).float()

    cls_path = os.path.join(data_dir, "clinical_modernbert_embeddings.parquet")
    if not os.path.exists(cls_path):
        build_text_cls_cache(encode, ids_by_case, mask_by_case, cls_path, batch_size,
                             device=device)
    tok_dir = os.path.join(data_dir, "clinical_modernbert_embeddings")
    if not os.path.isdir(tok_dir):
        build_text_token_cache(encode, ids_by_case, mask_by_case, tok_dir, batch_size,
                               device=device)
    return tok_dir


def main(argv=None):
    args = build_parser().parse_args(argv)
    d = args.data_dir

    desc_path = os.path.join(d, "descriptions.json")
    if args.generate_descriptions and not os.path.exists(desc_path):
        from gemm_gan_tpu_torch.data.descriptions import (generate_descriptions,
                                                          hf_causal_generate_fn)

        generate_descriptions(hf_causal_generate_fn(args.llm), _load_metainfos(d),
                              out_path=desc_path)
    with open(desc_path) as f:
        descriptions = json.load(f)

    import torch
    from transformers import AutoTokenizer

    from gemm_gan_tpu_torch.cli.convert_encoders import find_checkpoint, modernbert_weights
    from gemm_gan_tpu_torch.encoders.modernbert import ModernBert

    checkpoint = find_checkpoint(args.modernbert)
    tokenizer = AutoTokenizer.from_pretrained(os.path.dirname(checkpoint))
    p, sd, _ = modernbert_weights(checkpoint)
    dtype = torch.bfloat16 if args.encoder_dtype == "bfloat16" else torch.float32
    model = ModernBert(p, dtype=dtype, device=args.device)
    model.load_state_dict(sd)
    ids_by_case, mask_by_case = tokenize(tokenizer, descriptions, args.max_length)
    tok_dir = encode_caches(model, ids_by_case, mask_by_case, d, args.batch_size,
                            device=args.device)
    print(json.dumps({"cases_encoded": len(ids_by_case)}))

    if args.contrastive_dim > 0:
        contrastive(d, tok_dir, args.contrastive_dim, args.contrastive_epochs, args.device)


def contrastive(d: str, tok_dir: str, emb_dim: int, epochs: int, device=None) -> dict:
    """Train the projection pair on (mean patch embedding, CLS) pairs of the
    cases with both, then write the projected caches under `d`."""
    import pandas as pd

    from gemm_gan_tpu_torch.encoders.cache import build_contrastive_caches
    from gemm_gan_tpu_torch.encoders.contrastive import ContrastiveConfig, ContrastiveEngine

    patch_dir = os.path.join(d, "patch_embeddings_uni")
    cls_df = pd.read_parquet(os.path.join(d, "clinical_modernbert_embeddings.parquet"))
    pairs = []
    for case in cls_df.index:
        ppath = os.path.join(patch_dir, f"{case}.npy")
        if os.path.exists(ppath):
            pairs.append((np.load(ppath).mean(0), cls_df.loc[case].to_numpy()))
    img = np.stack([a for a, _ in pairs]).astype(np.float32)
    txt = np.stack([b for _, b in pairs]).astype(np.float32)

    cfg = ContrastiveConfig(image_dim=img.shape[1], text_dim=txt.shape[1], emb_dim=emb_dim)
    eng = ContrastiveEngine(cfg, device=device)
    state = eng.init_state(0)
    rng = np.random.RandomState(0)
    bs = min(256, img.shape[0])
    for _ in range(epochs):
        order = rng.permutation(img.shape[0])
        for s in range(0, len(order) - bs + 1, bs):
            idx = order[s:s + bs]
            state, _ = eng.step(state, img[idx], txt[idx])

    build_contrastive_caches(
        project_image=lambda x: eng.project(state, image_emb=x),
        project_text=lambda x: eng.project(state, text_emb=x),
        patch_cache_dir=patch_dir, token_cache_dir=tok_dir, out_root=d, emb_dim=emb_dim)
    out = {"contrastive_pairs": len(pairs), "emb_dim": emb_dim}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
