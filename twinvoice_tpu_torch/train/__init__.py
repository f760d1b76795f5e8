"""Segmenter training (``twinvoice_tpu.train``): losses, the learning-rate
schedule, metrics, checkpoints, visual dumps and the trainer."""
