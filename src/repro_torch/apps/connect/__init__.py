"""The CONNECT case study (paper §III): FFN segmentation of IVT volumes and
CONNECT object labelling, as a measured, resumable workflow."""
