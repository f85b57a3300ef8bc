"""The LM families (port of ``repro/models``): the model config, the
layers, the decoder stack (dense, MoE, SSM and hybrid), the
encoder-decoder, and the registry of the ten configs with the serving
step functions.  Start at :mod:`repro_torch.models.registry`."""
