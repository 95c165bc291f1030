from . import util
from . import inference
