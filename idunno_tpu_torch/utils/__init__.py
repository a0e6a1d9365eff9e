from idunno_tpu_torch.utils.types import MemberStatus, MessageType  # noqa: F401
from idunno_tpu_torch.utils.ring import hash_ring_index, ring_order  # noqa: F401
