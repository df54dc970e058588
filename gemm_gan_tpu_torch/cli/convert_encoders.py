"""Conversion of the pretrained encoder checkpoints to the port's modules.

Counterpart of `gemm_gan_tpu/cli/convert_encoders.py`. Point it at UNI
(timm `MahmoodLab/uni`, ViT-L/16 with LayerScale) and Clinical ModernBERT
(`Simonlee711/Clinical_ModernBERT`, ModernBERT-base) checkpoints: an
explicit file or dir, or a hub id resolved in the local HF cache only. It
never reaches the network. Each is loaded into the port's names (timm's
for `encoders.vit.ViT`, HF's for `encoders.modernbert.ModernBert`),
**validated against the published dims** (303,350,784 and 149,014,272
params) and written as a `torch.save`d state dict with a manifest (sha256,
bytes, param count, the architecture):

  python -m gemm_gan_tpu_torch.cli.convert_encoders --out ENC_DIR \
      [--uni MahmoodLab/uni | /path/to/pytorch_model.bin] \
      [--modernbert Simonlee711/Clinical_ModernBERT | /path/to/dir]

  sd = load_converted("ENC_DIR/uni_vit_l16.pt")
  vit = ViT(ViTParams()); vit.load_state_dict(sd)        # strict

`.bin` and `.pth` load with `torch.load(weights_only=True)`;
`.safetensors` needs the `safetensors` package, imported when such a file
is read. bf16 tensors are upcast to f32.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import torch

# checkpoint file names in preference order
_CANDIDATES = ("model.safetensors", "pytorch_model.bin")


def find_checkpoint(spec: str) -> str:
    """Resolve `spec` (file, dir, or HF hub id) to a checkpoint file. Hub
    ids resolve against the local HF cache only
    (`$HF_HOME/hub/models--ORG--NAME/snapshots/*/`, the snapshot
    `refs/main` names first); populate it elsewhere with `huggingface-cli
    download <id>`."""
    if os.path.isfile(spec):
        return spec
    roots = [spec] if os.path.isdir(spec) else []
    if "/" in spec and not roots:  # hub id -> HF cache layout
        repo = os.path.join(os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface")),
                            "hub", "models--" + spec.replace("/", "--"))
        snaps = sorted(glob.glob(os.path.join(repo, "snapshots", "*")))
        rev = None
        try:
            with open(os.path.join(repo, "refs", "main")) as f:
                rev = f.read().strip()
        except OSError:
            pass
        current = os.path.join(repo, "snapshots", rev) if rev else None
        if current and os.path.isdir(current):
            snaps = [current] + [s for s in snaps if s != current]
        elif len(snaps) > 1:
            # no usable refs/main: the newest snapshot, named in a warning
            snaps.sort(key=os.path.getmtime, reverse=True)
            print(f"warning: {spec}: {len(snaps)} cached snapshots and no usable "
                  f"refs/main; picking {snaps[0]} (newest mtime wins); pass an "
                  f"explicit path to be sure", flush=True)
        roots = snaps
    for root in roots:
        for name in _CANDIDATES:
            path = os.path.join(root, name)
            if os.path.isfile(path):
                return path
    raise FileNotFoundError(
        f"no checkpoint for {spec!r}: looked for {_CANDIDATES} in "
        f"{roots or ['<HF cache>']}; download it on a machine with network access "
        f"with `huggingface-cli download {spec}` or pass an explicit file path")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file as name -> CPU tensor, floating tensors in f32."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"reading {path} needs the `safetensors` package, which "
                              "is not installed; pass a .bin / .pth checkpoint") from e
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
    return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}


def _save(sd: Dict[str, torch.Tensor], out_path: str, meta: Dict) -> Dict:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.save(sd, out_path)
    with open(out_path, "rb") as f:
        blob = f.read()
    manifest = dict(meta, sha256=hashlib.sha256(blob).hexdigest(), bytes=len(blob),
                    path=os.path.abspath(out_path))
    with open(out_path + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_converted(path: str) -> Dict[str, torch.Tensor]:
    """A state dict written by this command."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _validate_or_explain(validate, sd, p, checkpoint: str, arch: str) -> int:
    """The layout check, its failure turned into a diagnostic that names
    the published architecture."""
    try:
        return validate(sd, p)
    except ValueError as e:
        raise SystemExit(f"{checkpoint}: not a {arch} checkpoint (expected the published "
                         f"architecture {p}):\n{e}") from e


def uni_weights(checkpoint: str):
    """(ViTParams, validated state dict, param count) of a UNI checkpoint
    file."""
    from gemm_gan_tpu_torch.encoders.vit import ViTParams, validate_vit_layout

    p = ViTParams()  # the published UNI dims: ViT-L/16, LayerScale, 224x224
    sd = load_state_dict(checkpoint)
    n = _validate_or_explain(validate_vit_layout, sd, p, checkpoint, "UNI ViT-L/16")
    return p, sd, n


def modernbert_weights(checkpoint: str):
    """(ModernBertParams, validated state dict, param count) of a ModernBERT
    checkpoint file, its dims from a `config.json` beside it when there is
    one (else ModernBERT-base's)."""
    from gemm_gan_tpu_torch.encoders.modernbert import (ModernBertParams, from_hf_state_dict,
                                                        params_from_config,
                                                        validate_modernbert_layout)

    cfg_path = os.path.join(os.path.dirname(checkpoint), "config.json")
    p: Optional[ModernBertParams] = None
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            p = params_from_config(json.load(f))
    p = p or ModernBertParams()
    sd = from_hf_state_dict(load_state_dict(checkpoint))
    n = _validate_or_explain(validate_modernbert_layout, sd, p, checkpoint, "ModernBERT")
    return p, sd, n


def convert_uni(checkpoint: str, out_dir: str) -> Dict:
    """UNI timm checkpoint -> validated `ViT` state dict + manifest."""
    p, sd, n = uni_weights(checkpoint)
    return _save(sd, os.path.join(out_dir, "uni_vit_l16.pt"),
                 {"model": "uni_vit_l16", "source": checkpoint, "param_count": n,
                  "hidden_size": p.hidden_size, "num_layers": p.num_layers,
                  "params": dataclasses.asdict(p)})


def convert_modernbert(checkpoint: str, out_dir: str) -> Dict:
    """Clinical ModernBERT HF checkpoint -> validated `ModernBert` state
    dict + manifest."""
    p, sd, n = modernbert_weights(checkpoint)
    return _save(sd, os.path.join(out_dir, "clinical_modernbert.pt"),
                 {"model": "clinical_modernbert", "source": checkpoint, "param_count": n,
                  "hidden_size": p.hidden_size, "num_layers": p.num_layers,
                  "params": dataclasses.asdict(p)})


def build_parser():
    ap = argparse.ArgumentParser(description="convert UNI / Clinical ModernBERT "
                                             "checkpoints to validated port state dicts")
    ap.add_argument("--uni", default=None,
                    help="checkpoint file, dir, or hub id (MahmoodLab/uni)")
    ap.add_argument("--modernbert", default=None,
                    help="checkpoint file, dir, or hub id (Simonlee711/Clinical_ModernBERT)")
    ap.add_argument("--out", required=True, help="output directory")
    return ap


def main(argv=None) -> Tuple[Dict, ...]:
    args = build_parser().parse_args(argv)
    if not (args.uni or args.modernbert):
        build_parser().error("pass --uni and/or --modernbert")
    manifests = []
    for name, spec, fn in (("uni", args.uni, convert_uni),
                           ("modernbert", args.modernbert, convert_modernbert)):
        if spec is None:
            continue
        manifest = fn(find_checkpoint(spec), args.out)
        print(json.dumps({"converted": name, **manifest}), flush=True)
        manifests.append(manifest)
    return tuple(manifests)


if __name__ == "__main__":
    main()
