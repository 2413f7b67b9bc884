from . import flat
from .quantize import qms_clip, qms_quantize_ste, qms_quantize_value
from .ste import round_through, sign_through
