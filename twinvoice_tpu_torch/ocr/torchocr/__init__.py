"""The CTC text recognizer and text-line detector, in PyTorch: the port of
``twinvoice_tpu/ocr/jaxocr``, module for module.

- ``charset``   charsets (``cjk_charset`` from ``ocr.fonts``), greedy/beam/
                pattern-constrained CTC decoders
- ``lm``        the char 4-gram for beam search: the bundled one read, or
                built from ``data``'s sampler and saved
- ``data``      the training text samplers, CTC labels, and uint8 line
                batches read as float32
- ``model``     the CRNN forward at eval and in training (NCHW inside), its
                init, and its weights to and from the JAX layout
- ``train``     the CTC loss, optax's schedules, the train step, ``evaluate``,
                the weights file both packages read, and ``train``
- ``engine``    crop preparation and ``TorchOcrEngine`` (one device call a
                batch; the decoders on the host)
- ``textness``  the learned stride-4 textness head, its training and its
                weights file
- ``detector``  ``detect_lines`` (classical, learned, hybrid) and
                ``read_page``

The host steps OpenCV does in the JAX package are numpy here
(``twinvoice_tpu_torch.ops.host_image``). The renderers of the training
lines and pages (Pillow, OpenCV) stay in the JAX package: their output
reaches the training here as uint8 arrays in an npz.
"""

from twinvoice_tpu_torch.ocr.torchocr.charset import CHARSET, decode_ids, encode_text
from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine
