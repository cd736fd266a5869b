from pnnp_tpu_torch.physics.calibration import HALF_CLIP, ISO_TABLES, LEGAL_ISO, iso_index
from pnnp_tpu_torch.physics.darkshading import SonyDarkShading, PhoneDarkShading
