"""Study tools run as modules (``python -m opencv_dlco_tpu_torch.tools.<name>``)."""
