"""Training (counterpart of ``repro.training``): the synthetic data
pipeline, AdamW, the reference's checkpoint format and the fault-tolerant
loop.  The step itself is :func:`repro_torch.launch.steps.make_train_step`.
"""
