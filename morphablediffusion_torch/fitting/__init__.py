"""FLAME fitting of the PyTorch port: the morphable model, the staged
Levenberg-Marquardt landmark fit and its silhouette term."""

from morphablediffusion_torch.fitting.flame import (
    FlameModel,
    flame_forward,
    flame_landmarks,
    load_model,
    random_model,
    rodrigues,
)
from morphablediffusion_torch.fitting.fit import (
    FitConfig,
    fit_landmarks,
    fit_two_photos,
)
