"""The CTC text recognizer and text-line detector, in PyTorch: the port of
``twinvoice_tpu/ocr/jaxocr``, module for module.

- ``charset``   charsets, greedy/beam/pattern-constrained CTC decoders
- ``lm``        the bundled char 4-gram read for beam search
- ``model``     the CRNN forward at eval (NCHW inside) and its weights
- ``engine``    crop preparation and ``TorchOcrEngine`` (one device call a
                batch; the decoders on the host)
- ``textness``  the learned stride-4 textness head
- ``detector``  ``detect_lines`` (classical, learned, hybrid) and
                ``read_page``

The host steps OpenCV does in the JAX package are numpy here
(``twinvoice_tpu_torch.ops.host_image``).
"""

from twinvoice_tpu_torch.ocr.torchocr.charset import CHARSET, decode_ids, encode_text
from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine
