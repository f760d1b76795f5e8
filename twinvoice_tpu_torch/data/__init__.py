"""Segmentation datasets (``twinvoice_tpu.data``): ``dataset`` only; the
modules that make datasets with OpenCV (augment, synthetic, labelme) are not
ported."""

from twinvoice_tpu_torch.data.dataset import ArrayDataset, load_invoice_dataset, synthetic_dataset
