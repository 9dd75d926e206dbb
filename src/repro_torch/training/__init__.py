"""The denoiser trainer: ``optimizer`` (AdamW and schedules),
``train_step`` (gradient accumulation and the NaN guard) and ``loop``
(checkpoints, resume, preemption, rollback)."""
