"""The evaluation suite: metrics, LPIPS and the report (ducosy_tpu/eval)."""
