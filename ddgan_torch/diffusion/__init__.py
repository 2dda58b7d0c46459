from .schedules import (  # noqa: F401
    PosteriorCoefficients,
    extract,
    get_sigma_schedule,
    get_time_schedule,
    sample_from_model,
    sample_from_model_with_noise,
    sample_posterior,
    sample_posterior_with_noise,
    var_func_geometric,
    var_func_vp,
)
