"""Field fusion (``twinvoice_tpu.fusion``): QR and OCR readings merged into
an invoice's fields, with provenance."""

from twinvoice_tpu_torch.fusion.items import (
    sum_items_amount,
    adjust_items_to_total,
    pick_crop,
)
from twinvoice_tpu_torch.fusion.amount import extract_amount
from twinvoice_tpu_torch.fusion.classify import classify_invoice, CATEGORIES
from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor, InvoiceMeta
