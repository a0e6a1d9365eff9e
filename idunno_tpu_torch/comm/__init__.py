from idunno_tpu_torch.comm.message import Message  # noqa: F401
from idunno_tpu_torch.comm.transport import Transport  # noqa: F401
from idunno_tpu_torch.comm.inproc import InProcNetwork, InProcTransport  # noqa: F401
