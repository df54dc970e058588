"""A cell of the benchmark cut to widths a CPU test can hold."""

from perfbench import spec

TINY_MODEL = dict(n_genes=32, latent_dim=8, gen_dims=[16, 12], disc_dims=[16, 20])
TINY_FUSION = dict(cond_dim=16, text_dim=24, patch_dim=32, ff_dim=32, num_heads=2,
                   max_tokens=10)
TINY_TRAFFIC = dict(cases=40, patch_slots=12, min_valid_patches=6, num_patches=8, tokens=10,
                    min_valid_tokens=3, trace_steps_per_epoch=2)


def tiny_cell(workload: str = "film_xattn_f32.train_cohort"):
    cell = spec.load_cell(workload)
    cell.config["model"].update(TINY_MODEL)
    cell.config["fusion"].update(TINY_FUSION)
    cell.traffic.update(TINY_TRAFFIC)
    return cell
