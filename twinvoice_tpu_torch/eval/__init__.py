"""The perturbation gauntlet (``twinvoice_tpu.eval``): its perturbed tiers,
its scoring on the port's segmenter and extractor, and its case files."""

from twinvoice_tpu_torch.eval.gauntlet import (  # noqa: F401
    GauntletCase,
    LEVELS,
    load_cases,
    perturb_cases,
    run_segmenter_gauntlet,
    run_e2e_gauntlet,
    save_cases,
)
