"""Predictor zoo. Importing this package registers the ported
predictors with the model factory (`gptst_tpu_torch.models.build`)."""

import gptst_tpu_torch.models.build  # noqa: F401  (registrations live there)
