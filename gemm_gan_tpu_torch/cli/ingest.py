"""Dataset ingest: GDC manifests -> expression matrix + patch-embedding cache.

Counterpart of `gemm_gan_tpu/cli/ingest.py`:

  python -m gemm_gan_tpu_torch.cli.ingest \
      --rna_manifests m1.txt m2.txt --tissue_manifests t1.txt \
      --out_dir DIR [--uni_checkpoint uni.bin] [--tile_size 256] [--device cpu]

Stages: map manifests to cases -> select one primary-tumor RNA file and one
bottom-preferred slide per case -> download the RNA TSVs -> build
rna_seq.parquet -> fetch the case metadata -> (with OpenSlide and a UNI
checkpoint) stream slides through Otsu tiling and the port's UNI `ViT` on
the card into patch_embeddings_uni/. The GDC stages are host code
(`data/gdc.py`) and need the GDC API; re-runs skip what exists.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import pandas as pd


def read_manifest(path: str) -> pd.DataFrame:
    """GDC manifest TSV: columns id, filename, md5, size, state."""
    df = pd.read_csv(path, sep="\t")
    return df.rename(columns={"id": "file_id", "filename": "file_name"})


def build_parser():
    p = argparse.ArgumentParser(description="gemm_gan_tpu_torch dataset ingest")
    p.add_argument("--rna_manifests", nargs="+", required=True)
    p.add_argument("--tissue_manifests", nargs="+", default=[])
    p.add_argument("--out_dir", required=True)
    p.add_argument("--max_workers", type=int, default=5)
    p.add_argument("--tile_size", type=int, default=256)
    p.add_argument("--max_cases", type=int, default=0, help="0 = all")
    p.add_argument("--uni_checkpoint", default="",
                   help="UNI checkpoint (file, dir or cached hub id; .bin / .pth / "
                        ".safetensors, or cli.convert_encoders' .pt); enables embedding")
    p.add_argument("--skip_slides", action="store_true")
    p.add_argument("--encoder_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="UNI embedding compute dtype; outputs are cast back "
                        "to f32 before caching")
    p.add_argument("--device", default=None,
                   help="'cpu' to run the encoder on the CPU; default: CUDA")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from gemm_gan_tpu_torch.data.gdc import (DatasetIndex, GDCClient,
                                       build_expression_matrix, download_many,
                                       select_rna_seq_files,
                                       select_tissue_slides,
                                       write_case_artifacts)

    os.makedirs(args.out_dir, exist_ok=True)
    client = GDCClient()

    rna_manifest = pd.concat([read_manifest(m) for m in args.rna_manifests])
    rna_entities = client.rna_file_entities(rna_manifest["file_name"].tolist())
    rna_sel = select_rna_seq_files(rna_entities)

    if args.tissue_manifests and not args.skip_slides:
        slide_manifest = pd.concat([read_manifest(m)
                                    for m in args.tissue_manifests])
        slide_entities = client.slide_file_entities(
            slide_manifest["file_name"].tolist())
        slide_sel = select_tissue_slides(
            slide_entities, rna_sel["portion_submitter_id"].tolist())
    else:
        slide_sel = pd.DataFrame({"case_id": rna_sel["case_id"],
                                  "file_name": ""})

    index = DatasetIndex.build(rna_sel[["case_id", "file_name"]],
                               slide_sel[["case_id", "file_name"]])
    if args.max_cases:
        keep = index.case_ids()[:args.max_cases]
        index.cases = {c: index.cases[c] for c in keep}
    index.save(os.path.join(args.out_dir, "dataset_index.json"))

    rna_dir = os.path.join(args.out_dir, "rna_seq")
    dl = download_many(client, rna_sel[rna_sel["case_id"].isin(index.cases)],
                       rna_dir, max_workers=args.max_workers)
    print(json.dumps({"rna_downloaded": sum(dl.values()), "rna_total": len(dl)}))

    build_expression_matrix(index, rna_dir,
                            os.path.join(args.out_dir, "rna_seq.parquet"))

    metainfos = client.case_metadata(index.case_ids())
    write_case_artifacts(index, metainfos, args.out_dir)

    if args.uni_checkpoint and args.tissue_manifests and not args.skip_slides:
        _embed_slides(args, client, index, slide_sel)
    print(json.dumps({"cases": len(index.cases), "out_dir": args.out_dir}))


def _embed_slides(args, client, index, slide_sel):
    """Stream slides: download -> Otsu tiles -> the UNI `ViT` -> patch cache."""
    from gemm_gan_tpu_torch.cli.convert_encoders import find_checkpoint, uni_weights
    from gemm_gan_tpu_torch.data.ingest import IngestPipeline
    from gemm_gan_tpu_torch.data.tiles import (extract_tiles, open_slide, otsu_mask,
                                               read_tile, slide_thumbnail)
    from gemm_gan_tpu_torch.encoders.vit import preprocess_tiles

    _, sd, _ = uni_weights(find_checkpoint(args.uni_checkpoint))
    embed_fn = uni_embedder(sd, args.encoder_dtype, args.device)

    file_by_case = dict(zip(slide_sel["case_id"], slide_sel["file_name"]))
    id_by_case = dict(zip(slide_sel["case_id"], slide_sel["file_id"]))
    slide_dir = os.path.join(args.out_dir, "tissue")
    os.makedirs(slide_dir, exist_ok=True)

    def download(case_id):
        dest = os.path.join(slide_dir, file_by_case[case_id])
        if os.path.exists(dest):
            return dest
        return dest if client.download_file(id_by_case[case_id], dest) else None

    def tile(case_id, path):
        slide = open_slide(path)
        mask = otsu_mask(slide_thumbnail(slide))
        boxes = extract_tiles(mask, slide.level_dimensions[0], args.tile_size)
        tiles = np.stack([read_tile(slide, x, y, args.tile_size) for x, y, _, _ in boxes])
        return preprocess_tiles(tiles)

    pipe = IngestPipeline(download, tile, embed_fn,
                          os.path.join(args.out_dir, "patch_embeddings_uni"),
                          max_download_workers=args.max_workers)
    results = pipe.run([c for c in index.case_ids() if c in file_by_case])
    # per-case patch counts (valid_patches.json holds data/tiles.py's
    # {case: {size: boxes}}, another file)
    pipe.write_tiles_info(os.path.join(args.out_dir, "tiles_info.json"))
    ok = sum(r.status == "ok" for r in results)
    print(json.dumps({"slides_embedded": ok, "slides_total": len(results)}))


def uni_embedder(state_dict, encoder_dtype: str = "float32", device=None, batch_size: int = 64,
                 params=None):
    """The pipeline's embed stage: tiles [N, S, S, 3] (`preprocess_tiles`'
    output) -> the UNI `ViT` (`params`, by default UNI's ViT-L/16; weights
    `state_dict`; compute dtype `encoder_dtype`) in batches of `batch_size`
    on `device` -> float32 [N, E]."""
    import torch

    from gemm_gan_tpu_torch.encoders.cache import batched_apply
    from gemm_gan_tpu_torch.encoders.vit import ViT, ViTParams

    dtype = torch.bfloat16 if encoder_dtype == "bfloat16" else torch.float32
    vit = ViT(params or ViTParams(), dtype=dtype, device=device)
    vit.load_state_dict(state_dict)

    def embed_fn(tiles):
        return batched_apply(vit, tiles, batch_size, device=device).astype(np.float32)

    return embed_fn


if __name__ == "__main__":
    main()
