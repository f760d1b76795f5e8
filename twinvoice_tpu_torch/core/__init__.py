"""The rank grid, the collectives on it and the precision policy
(``twinvoice_tpu.core``)."""
