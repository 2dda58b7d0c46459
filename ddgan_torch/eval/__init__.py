"""Evaluation: FID (Inception pool3 statistics and the Fréchet distance) and
the Inception Score.

The port's counterpart of `ddgan_tpu/eval/` (reference:
pytorch_fid/{fid_score,inception,inception_score}.py). The feature extractor
is the TF-FID InceptionV3 in PyTorch; its weights load from the standard
pt_inception-2015-12-05 checkpoint when present locally (no download).
"""

from .fid import (  # noqa: F401
    calculate_frechet_distance,
    calculate_activation_statistics,
    calculate_fid_given_paths,
    compute_statistics_of_path,
    get_activations,
)
from .inception_score import (  # noqa: F401
    get_inception_score,
    inception_score_from_probs,
)
from .inception import InceptionV3FID, load_fid_inception_params  # noqa: F401
