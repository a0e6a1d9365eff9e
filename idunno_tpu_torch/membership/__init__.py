from idunno_tpu_torch.membership.service import MembershipService  # noqa: F401
from idunno_tpu_torch.membership.list import MemberEntry, MembershipList  # noqa: F401
