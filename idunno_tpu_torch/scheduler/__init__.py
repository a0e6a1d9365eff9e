from idunno_tpu_torch.scheduler.tasks import Task, TaskBook  # noqa: F401
from idunno_tpu_torch.scheduler.fair import FairScheduler, fair_shares  # noqa: F401
