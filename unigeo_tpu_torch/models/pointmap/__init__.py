"""The pointmap family (port of ``unigeo_tpu/models/pointmap``): the shared
ViT encoder / decoder / heads, the DPT head, the camera-recovery adapter,
Spann3R, Dust3R and Cut3R."""
