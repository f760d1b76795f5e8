"""Persistence: the port of ``twinvoice_tpu/store``. ``base`` holds the row
shaping and the ``InvoiceStore`` protocol, ``memory`` the in-memory store,
``supabase_store`` the Supabase-backed one (its client imported only when
it is built from credentials)."""

from twinvoice_tpu_torch.store.base import InvoiceStore
from twinvoice_tpu_torch.store.memory import MemoryStore
