from xbitops.cli import main

raise SystemExit(main())
