"""UI layer: the port of ``twinvoice_tpu/app``. ``dashboard`` holds the
(Streamlit-free, pandas-free, testable) data aggregation; ``main`` is the
Streamlit app itself (it needs ``streamlit``, ``plotly`` and ``pandas``,
imported where it draws)."""

from twinvoice_tpu_torch.app.dashboard import (
    prepare_frames,
    monthly_totals,
    category_totals,
    year_summary,
)
