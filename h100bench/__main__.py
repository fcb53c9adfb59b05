import sys

from h100bench.run import main

sys.exit(main())
