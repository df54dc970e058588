"""Clinical description generation from GDC case metadata.

Capability parity with the reference's LLM description stage
(the reference's src/preprocessing/text_preprocessing.py): a biomedical
chat LLM is prompted with a flattened case-metadata dict and greedy-decodes
a ~200-word single-paragraph description prefixed with an "[/INST]" marker;
the parsed descriptions feed the ModernBERT embedding cache.

Redesign notes: the LLM call is injected (`generate_fn: str -> str`) so the
pipeline is testable offline and any backend (transformers host-side, an
API, a jitted Flax LM) can serve it; metadata pruning/flattening and output
parsing are pure functions.

A copy of `gemm_gan_tpu/data/descriptions.py` (host code: numpy, pandas and the
standard library; optional imports stay lazy), kept here so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, Optional

DESCRIPTION_MARKER = "[/INST]"

# Same contract as the reference prompt (text_preprocessing.py:11-27), own
# wording: ~200-word single-paragraph impersonal summary of disease type,
# primary site, demographics and treatments, marker-prefixed.
SYSTEM_PROMPT = f"""You write concise clinical summaries used to condition a \
synthetic gene-expression model. Given a patient metadata dictionary (which \
includes many irrelevant fields), produce one short paragraph of roughly 200 \
words covering: the disease type, the primary anatomical site, demographic \
context, and any recorded diagnoses or treatments. List every recorded \
diagnosis or treatment without guessing which is correct. Be impersonal and \
generic — never refer to the specific patient. Use plain English prose with \
no bullet points, enumerations, questions, or special formatting. Prefix the \
paragraph with the string "{DESCRIPTION_MARKER}" so it can be separated from \
the echoed metadata."""

# demographic sub-fields that carry no clinical signal (reference :63-75)
_DEMOGRAPHIC_DROP = ("demographic_id", "updated_datetime", "submitter_id",
                     "days_to_birth")
_TOP_LEVEL_DROP = ("samples", "case_id", "submitter_id", "project")


def prune_metadata(case_metadata: dict) -> dict:
    """Drop identifier/bookkeeping fields before prompting."""
    md = {k: v for k, v in case_metadata.items() if k not in _TOP_LEVEL_DROP}
    demo = md.get("demographic")
    if isinstance(demo, dict):
        md["demographic"] = {k: v for k, v in demo.items()
                             if k not in _DEMOGRAPHIC_DROP}
    return md


def format_metadata(case_metadata: dict) -> str:
    """Flatten the pruned dict to `key: ...` lines (dicts inline k: v pairs
    skipping Nones; lists joined)."""
    lines = []
    for key, value in prune_metadata(case_metadata).items():
        if isinstance(value, dict):
            inner = ", ".join(f"{k}: {v}" for k, v in value.items()
                              if v is not None)
            lines.append(f"{key}: {inner}")
        elif isinstance(value, list):
            lines.append(f"{key}: {', '.join(str(v) for v in value)}")
        else:
            lines.append(f"{key}: {value}")
    return "\n".join(lines)


def parse_generation(text: str) -> str:
    """Split the decoded chat transcript at the marker; if the model only
    echoed the marker from the prompt (count <= 1), fall back to the last
    line (reference :104-108)."""
    if text.count(DESCRIPTION_MARKER) > 1:
        return text.split(DESCRIPTION_MARKER)[-1].strip()
    return text.split("\n")[-1].strip()


def generate_descriptions(generate_fn: Callable[[str, str], str],
                          metainfos: Dict[str, Optional[dict]],
                          case_ids: Optional[Iterable[str]] = None,
                          out_path: Optional[str] = None) -> Dict[str, str]:
    """Run `generate_fn(system_prompt, metadata_str) -> decoded text` per
    case; parse; optionally write descriptions.json."""
    case_ids = list(case_ids) if case_ids is not None else sorted(metainfos)
    out: Dict[str, str] = {}
    for case_id in case_ids:
        md = metainfos.get(case_id)
        if md is None:
            out[case_id] = ""
            continue
        raw = generate_fn(SYSTEM_PROMPT, format_metadata(md))
        out[case_id] = parse_generation(raw)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def hf_causal_generate_fn(model_name: str = "ContactDoctor/Bio-Medical-Llama-3-8B",
                          max_new_tokens: int = 512, device: str = "cpu"):
    """Heavy host-side backend: greedy decode with a transformers causal LM
    (the reference runs it 4-bit on CUDA; here CPU/bf16 — eval-time only)."""
    import torch
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_name)
    model = AutoModelForCausalLM.from_pretrained(model_name).to(device).eval()
    pad_id = tokenizer.pad_token_id or tokenizer.eos_token_id

    def generate(system_prompt: str, metadata_str: str) -> str:
        messages = [{"role": "system", "content": system_prompt},
                    {"role": "user", "content": metadata_str}]
        inputs = tokenizer.apply_chat_template(messages, return_tensors="pt"
                                               ).to(device)
        with torch.no_grad():
            out = model.generate(inputs, max_new_tokens=max_new_tokens,
                                 do_sample=False, pad_token_id=pad_id,
                                 eos_token_id=tokenizer.eos_token_id)
        return tokenizer.decode(out[0], skip_special_tokens=True)

    return generate
