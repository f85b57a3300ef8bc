"""Training substrate: optimizer, train step, data pipeline (port of
``repro/training``)."""
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.training.train_step import TrainConfig, make_train_step  # noqa: F401
from repro_torch.training.data import SyntheticCorpus, MemmapCorpus  # noqa: F401
