"""The VLM labeling chain (port of pixie_tpu/vlm_labeler/)."""
