"""Segmentation datasets (``twinvoice_tpu.data``): ``dataset`` only; the
modules that make datasets with OpenCV (augment, synthetic, labelme) are not
ported."""
