"""Streamlit application — capture tab + spending dashboard: the port of
``twinvoice_tpu/app/main.py``, with the same Streamlit calls in the same
order.

Feature parity with the reference UI (app_camera.py:982-1286): upload or
camera-capture a receipt, run recognition, review/edit category, save;
dashboard with year filter, total metric, monthly bar, per-invoice expanders
with item tables + delete, category pie, retro warm palette.

- the recognition engine is ``InvoiceExtractor`` on the card, held in the
  session (the model loads once); its local recognizer is
  ``TorchOcrEngine``, OCR.space joins it when ``OCR_SPACE_API_KEY`` is set
  and EasyOCR when it is installed
- the segmenter is ``TWINVOICE_PTH``'s ``.pth`` or ``TWINVOICE_CKPT``'s
  checkpoint at bf16, else the bundled one
- storage is the InvoiceStore protocol (Supabase when ``SUPABASE_URL`` and
  ``SUPABASE_KEY`` reach a client, else in memory)
- the dashboard's aggregation (``app.dashboard``) needs no pandas; the
  charts and tables are pandas frames made here

Run: ``python -m twinvoice_tpu_torch app`` (needs ``streamlit``,
``plotly`` and ``pandas``).
"""

from __future__ import annotations

import io
import os

# retro warm palette (visual parity with the reference theme,
# app_camera.py:921-932, .streamlit/config.toml)
PALETTE = ["#993333", "#CC7357", "#5F7057", "#B8A699", "#A49375", "#333333"]
BG = "#F2F0EC"
FG = "#555555"

_MONTH_COLUMNS = ["month", "total_amount", "month_label"]
_CATEGORY_COLUMNS = ["category", "total_amount"]
_ITEM_COLUMNS = ["name", "qty", "price", "amount"]


def _build_engine(device=None):
    """Construct the recognition stack once per session; ``device=None``
    means the card."""
    import torch

    from twinvoice_tpu_torch.config import Config
    from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
    from twinvoice_tpu_torch.infer.pipeline import Segmenter
    from twinvoice_tpu_torch.ocr.easyocr_engine import EasyOcrEngine
    from twinvoice_tpu_torch.ocr.ocrspace import OcrSpaceEngine
    from twinvoice_tpu_torch.qr.detect import QrPipeline

    cfg = Config()
    ckpt = os.environ.get("TWINVOICE_CKPT", "")
    pth = os.environ.get("TWINVOICE_PTH", "")
    if pth:
        seg = Segmenter.from_pth(pth, cfg.model, cfg.infer, dtype=torch.bfloat16,
                                 device=device)
    elif ckpt:
        seg = Segmenter.from_checkpoint(ckpt, cfg.model, cfg.infer, dtype=torch.bfloat16,
                                        device=device)
    else:
        from twinvoice_tpu_torch.models import pretrained

        seg = pretrained.load_pretrained_segmenter(infer_cfg=cfg.infer, device=device)

    engines = []
    space = OcrSpaceEngine()
    if space.available():
        engines.append(space)
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

    local = TorchOcrEngine(device=device)  # the port's local recognizer
    if local.available():
        engines.append(local)
    easy = EasyOcrEngine()
    if easy.available():
        engines.append(easy)
    return InvoiceExtractor(seg, QrPipeline(), engines, cfg.fusion)


def _build_store():
    from twinvoice_tpu_torch.store.memory import MemoryStore
    from twinvoice_tpu_torch.store.supabase_store import SupabaseStore

    store = SupabaseStore()
    return store if store.available() else MemoryStore()


def _theme(fig):
    fig.update_layout(
        font=dict(color=FG), plot_bgcolor=BG, paper_bgcolor=BG, legend_title_text=""
    )
    return fig


def capture_tab(st, extractor, store):
    from PIL import Image

    from twinvoice_tpu_torch.fusion.classify import CATEGORIES, classify_invoice

    st.header("上傳發票或使用相機拍照")
    pil_img = None
    uploaded = st.file_uploader("上傳發票照片（JPG/PNG）", type=["jpg", "png", "jpeg"])
    if uploaded:
        pil_img = Image.open(io.BytesIO(uploaded.getvalue())).convert("RGB")
    shot = st.camera_input("或將發票對準鏡頭拍照")
    if shot:
        pil_img = Image.open(io.BytesIO(shot.getvalue())).convert("RGB")
    if pil_img is None:
        st.info("請上傳照片或使用相機拍照")
        return
    st.image(pil_img, use_container_width=True)

    if st.button("開始辨識", type="primary"):
        with st.spinner("辨識中..."):
            meta, items, qr_raw = extractor.extract(pil_img)
        st.session_state["last_result"] = (meta, items)

    if "last_result" in st.session_state:
        meta, items = st.session_state["last_result"]
        col1, col2 = st.columns(2)
        with col1:
            st.markdown(f"📄 **發票號碼**：{meta.get('invoice_no') or '-'}")
            st.markdown(f"📅 **日期**：{meta.get('date') or '-'}")
            st.markdown(f"💰 **總金額**：NT$ {meta.get('total_amount') or '0'}")
        with col2:
            st.caption(f"號碼來源：{meta.get('source')}")
            st.caption(f"日期來源：{meta.get('date_source')}")
            st.caption(f"金額來源：{meta.get('amount_source')}")
        if items:
            import pandas as pd

            st.dataframe(pd.DataFrame(items), use_container_width=True, hide_index=True)
        else:
            st.info("只有總金額，無明細品項")

        predicted = classify_invoice(meta, items)
        category = st.selectbox(
            "選擇消費類別", list(CATEGORIES), index=list(CATEGORIES).index(predicted)
        )
        meta["category"] = category

        if st.button("儲存發票", use_container_width=True):
            invoice_id = store.save_invoice(meta, items)
            if invoice_id is not None:
                st.success(f"✅ 已儲存（id={invoice_id}）")
                st.session_state.pop("dashboard_cache", None)
            else:
                st.error("❌ 儲存失敗，請檢查儲存設定")


def dashboard_tab(st, store):
    import pandas as pd
    import plotly.express as px

    from twinvoice_tpu_torch.app import dashboard as D

    st.markdown("## 消費儀表板 Dashboard")
    if "dashboard_cache" not in st.session_state:
        st.session_state["dashboard_cache"] = (
            store.list_invoices(500), store.list_items(5000)
        )
    inv_rows, item_rows = st.session_state["dashboard_cache"]
    df, df_items = D.prepare_frames(inv_rows, item_rows)
    if not df:
        st.info("尚無任何發票資料")
        return

    year = st.selectbox("選擇年度", D.years(df))
    df_year, total = D.year_summary(df, year)
    st.metric(f"{year} 年度總支出", f"NT$ {total:,}")

    st.markdown("### 每月支出趨勢")
    mon = pd.DataFrame(D.monthly_totals(df_year), columns=_MONTH_COLUMNS)
    st.plotly_chart(
        _theme(
            px.bar(
                mon, x="month_label", y="total_amount", color="month_label",
                labels={"month_label": "月份", "total_amount": "金額 (NT$)"},
                color_discrete_sequence=PALETTE,
            )
        ),
        use_container_width=True,
    )

    col_left, col_right = st.columns([1, 2])
    with col_right:
        st.markdown("### 發票明細")
        month_opts = ["全部月份"] + D.months_in(df_year)
        month_sel = st.selectbox("選擇月份", month_opts)
        month = None if month_sel == "全部月份" else month_sel
        for row in D.invoices_sorted(df_year, month):
            label = (
                f"{row['invoice_no']} • {row['date'].strftime('%m/%d')} • "
                f"NT$ {row['total_amount']:,} • {row['category']}"
            )
            with st.expander(label):
                st.caption(f"備註：{row.get('note') or '無'}")
                if st.button("刪除", key=f"del_{row['id']}"):
                    if store.delete_invoice(int(row["id"])):
                        st.session_state.pop("dashboard_cache", None)
                        st.rerun()
                its = D.items_for_invoice(df_items, row["id"])
                if not its:
                    st.caption("無品項資料")
                else:
                    st.dataframe(
                        pd.DataFrame(its, columns=_ITEM_COLUMNS),
                        use_container_width=True, hide_index=True,
                    )
    with col_left:
        st.markdown("### 類別支出分佈")
        pie = D.category_totals(df_year, month)
        if not pie:
            st.info("當前篩選條件無支出資料")
        else:
            st.plotly_chart(
                _theme(
                    px.pie(
                        pd.DataFrame(pie, columns=_CATEGORY_COLUMNS), names="category",
                        values="total_amount", hole=0.4,
                        color_discrete_sequence=PALETTE,
                    )
                ),
                use_container_width=True,
            )


def main():
    import streamlit as st

    st.set_page_config(page_title="TW Invoice (TPU)", layout="wide")
    if "engine" not in st.session_state:
        with st.spinner("載入模型中..."):
            st.session_state["engine"] = _build_engine()
            st.session_state["store"] = _build_store()
    extractor = st.session_state["engine"]
    store = st.session_state["store"]

    tab1, tab2 = st.tabs(["上傳發票", "消費儀表板"])
    with tab1:
        capture_tab(st, extractor, store)
    with tab2:
        dashboard_tab(st, store)


if __name__ == "__main__":
    main()
