"""QR payload parsers and the QR scan pipeline (``twinvoice_tpu.qr``)."""

from twinvoice_tpu_torch.qr.parse import (
    parse_header_qr,
    parse_items_qr,
    is_text_qr_payload,
    roc_date_to_iso,
)
from twinvoice_tpu_torch.qr.detect import QrPipeline, detect_qr_regions
