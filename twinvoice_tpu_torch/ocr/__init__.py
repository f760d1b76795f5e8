"""Text recognition: the port of ``twinvoice_tpu/ocr``.

``base`` holds the result type every engine returns; ``torchocr`` the CTC
recognizer, the text-line detector and the engine that reads field crops
and full pages with them.
"""
