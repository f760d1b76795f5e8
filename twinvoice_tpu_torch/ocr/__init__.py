"""Text recognition: the port of ``twinvoice_tpu/ocr``.

``base`` holds the result type every engine returns and the engine
protocol; ``fake`` the scripted engine of the tests; ``torchocr`` the CTC
recognizer, the text-line detector and the engine that reads field crops
and full pages with them.
"""

from twinvoice_tpu_torch.ocr.base import OcrEngine, OcrResult
from twinvoice_tpu_torch.ocr.fake import FakeOcrEngine
