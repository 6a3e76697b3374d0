"""Integer operators of the ITA datapath, as PyTorch functions."""
